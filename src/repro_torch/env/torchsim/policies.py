"""Static split deciders for compiled traces (the port of
``repro.env.jaxsim.policies``' static surface).

Compiled traces realize fragments on the host, so these deciders are
*static*: a pure function of the task (and optionally a frozen MAB
state).  Covered: fixed LAYER / SEMANTIC / COMPRESSED (the L+*, S+*, MC
arms), ``roundrobin`` (i % 3), ``threshold`` (layer when the SLA clears
1.6× the unloaded layer-chain reference) and ``mab-static`` (UCB
decisions from a frozen ``MABState``).  Placement for all of them is the
BestFit stage of the interval program; ``host_policy`` pairs the same
decider with the host loop's ``BestFitPlacer``.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.core import mab as mab_mod
from repro_torch.env.workload import (COMPRESSED, LAYER, SEMANTIC,
                                      layer_ref_response_s)

#: policy names the compiled-trace path accepts (all BestFit-placed)
STATIC_POLICIES = ("mc", "bestfit-layer", "bestfit-semantic", "bestfit-rr",
                   "bestfit-threshold", "bestfit-mab")

#: the in-loop learned policies that consume a pretrained ``MABState``:
#: "mab" places with BestFit, "splitplace" with the DASO stage, "mab+gobi"
#: with its decision-blind ablation (the surrogate input's decision one-hot
#: slice zeroed, ``daso_cfg.decision_aware=False``)
MAB_LEARNED_POLICIES = ("mab", "splitplace", "mab+gobi")

#: the subset that also consumes the pretrained DASO surrogate (θ + cfg)
DASO_LEARNED_POLICIES = ("splitplace", "mab+gobi")

#: every in-loop learned policy: the MAB policies and the Gillis baseline
#: (contextual ε-greedy Q-learning, which needs no pretraining products)
LEARNED_POLICIES = MAB_LEARNED_POLICIES + ("gillis",)


class _StaticDecider:
    """A decider no outcome changes: its feedback does nothing (the host
    loop calls it every interval)."""

    def feedback(self, finished) -> None:
        pass


class StaticFixedDecider(_StaticDecider):
    def __init__(self, decision: int, name: str):
        self.decision = decision
        self.name = name

    def decide(self, tasks) -> List[int]:
        return [self.decision] * len(tasks)


class RoundRobinDecider(_StaticDecider):
    """i % 3 over each interval's arrivals."""
    name = "bestfit-rr"

    def decide(self, tasks) -> List[int]:
        return [i % 3 for i in range(len(tasks))]


class ThresholdDecider(_StaticDecider):
    """LAYER when the deadline clears ``margin``× the unloaded layer-split
    reference time (batch-scaled), else SEMANTIC."""
    name = "bestfit-threshold"

    def __init__(self, margin: float = 1.6):
        self.margin = margin

    def decide(self, tasks) -> List[int]:
        out = []
        for t in tasks:
            ref = layer_ref_response_s(t.app) * t.batch / 40000.0
            out.append(LAYER if t.sla_s >= self.margin * ref else SEMANTIC)
        return out


class StaticMABDecider(_StaticDecider):
    """Frozen-state UCB decisions (deploy-mode MAB without the feedback
    loop).  ``state`` is a port ``MABState`` with a grid axis of 1, or the
    reference's fields as a dict of NumPy arrays; decisions run on the
    CPU."""
    name = "bestfit-mab"

    def __init__(self, state, ucb_c: float = 0.5):
        if state is None:
            raise ValueError("bestfit-mab needs a pretrained mab_state")
        if isinstance(state, mab_mod.MABState):
            state = {k: v[0] for k, v in
                     mab_mod.mab_state_to_numpy(state).items()}
        self.state = mab_mod.mab_state_from_numpy(state, device="cpu")
        self.ucb_c = ucb_c

    def decide(self, tasks) -> List[int]:
        if not tasks:
            return []
        sla = torch.tensor(np.array(
            [[np.float32(t.sla_s * 40000.0 / max(t.batch, 1))
              for t in tasks]], np.float32))
        app = torch.tensor([[t.app for t in tasks]], dtype=torch.int32)
        d, _ = mab_mod.decide_ucb_batch(self.state, sla, app, self.ucb_c)
        return [int(x) for x in d[0]]


def make_static_decider(policy: str, mab_state=None, seed: int = 0):
    """Resolve a compiled-trace policy name to its decider (``seed`` is
    accepted and ignored: static deciders are deterministic)."""
    del seed
    table = {
        "mc": lambda: StaticFixedDecider(COMPRESSED, "mc"),
        "bestfit-layer": lambda: StaticFixedDecider(LAYER, "bestfit-layer"),
        "bestfit-semantic": lambda: StaticFixedDecider(SEMANTIC,
                                                       "bestfit-semantic"),
        "bestfit-rr": RoundRobinDecider,
        "bestfit-threshold": ThresholdDecider,
        "bestfit-mab": lambda: StaticMABDecider(mab_state),
    }
    if policy not in table:
        raise ValueError(f"policy {policy!r} is not static (have "
                         f"{STATIC_POLICIES})")
    return table[policy]()


def host_policy(policy: str, mab_state=None, seed: int = 0):
    """The same (static decider, BestFit) pair as a host ``Policy`` object
    for the host interval loop (``run_trace(backend="soa", policy=...)``),
    to compare the two backends on identical policy behaviour."""
    from repro_torch.core.splitplace import BestFitPlacer, Policy
    return Policy(policy, make_static_decider(policy, mab_state, seed),
                  BestFitPlacer())
