"""Batched experiment runner of the port — (seed × λ) grids for one policy.

``run_grid_batched`` is the port of ``repro.launch.experiments
.run_grid_batched`` for the static BestFit policies, the MAB policies
``"mab"``, ``"splitplace"`` and ``"mab+gobi"`` in ``mode="deploy"``, and
the static-decider DASO arms ``"layer+gobi"`` and ``"semantic+gobi"``: the
whole grid runs as one batched interval program on the device (one row per
grid cell).  Every other policy or mode raises ``NotImplementedError``
naming the ROADMAP item that brings it.  ``pretrain`` is not ported: the
DASO policies take θ and its cfg from the caller.
"""
from __future__ import annotations

import itertools
from typing import List, Optional, Sequence

from repro_torch.env import torchsim
from repro_torch.env.torchsim.driver import MAB_HP

#: policies of the reference not ported yet, with the ROADMAP queue-1
#: item that brings each
NOT_PORTED = {
    "random+daso": "item 7 (in-loop randomness: the random arm's fold-in "
                   "bits)",
    "gillis": "item 7 (in-loop randomness and training)",
}

_SCALARS = (int, float)


def _record(pol: str, seed: int, lam: float, summary: dict) -> dict:
    rec = {"policy": pol, "seed": seed, "lam": lam}
    rec.update({k: float(v) for k, v in summary.items()
                if isinstance(v, _SCALARS) and not isinstance(v, bool)})
    return rec


def run_grid_batched(policy: str = "mc", seeds: Sequence[int] = (0,),
                     lams: Sequence[float] = (6.0,), n_intervals: int = 100,
                     substeps: int = 30, interval_s: float = 300.0,
                     apps=None, cluster=None, mab_state=None, seed_offset=0,
                     max_active: Optional[int] = None, daso_theta=None,
                     daso_cfg=None, mab_hp=None, mode: str = "deploy",
                     device="cuda",
                     phase_s: Optional[dict] = None) -> List[dict]:
    """Run a whole (seed × λ) grid for one policy as ONE batched interval
    program on ``device``; one record per trace, in
    ``itertools.product(lams, seeds)`` order.

    Static policies (``torchsim.STATIC_POLICIES``) compile single-variant
    traces.  The MAB policies (``torchsim.MAB_LEARNED_POLICIES``) compile
    dual traces and carry one copy of ``mab_state`` per cell (online UCB
    decisions + Algorithm-1 feedback); ``"mab"`` places with BestFit,
    ``"splitplace"`` with the DASO stage ascending ``daso_theta`` under
    ``daso_cfg``, ``"mab+gobi"`` with the same cfg made decision-blind.
    ``"layer+gobi"`` / ``"semantic+gobi"`` fix the split and place with
    the decision-blind DASO stage; they need θ and cfg but no
    ``mab_state``.  ``phase_s`` collects the wall seconds of the program's
    phases (see ``driver.PHASES``).  Records report ``dropped_tasks`` (0
    unless ``max_active`` was forced too small)."""
    if mode not in ("deploy", "train"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "train":
        raise NotImplementedError(
            "mode='train' is not ported yet (ROADMAP queue 1 item 7: "
            "in-loop randomness and training)")
    if policy in NOT_PORTED:
        raise NotImplementedError(f"policy {policy!r} is not ported yet "
                                  f"(ROADMAP queue 1 {NOT_PORTED[policy]})")
    cells = list(itertools.product(lams, seeds))
    mab = policy in torchsim.MAB_LEARNED_POLICIES
    daso = policy in torchsim.DASO_LEARNED_POLICIES \
        or policy in torchsim.STATIC_DASO_ARMS
    if daso and (daso_theta is None or daso_cfg is None):
        raise ValueError(f"policy {policy!r} needs daso_theta/daso_cfg")
    if mab and mab_state is None:
        raise ValueError(f"policy {policy!r} needs a pretrained mab_state")
    if mab or daso:
        traces = [torchsim.compile_trace_dual(
            lam=lam, seed=seed + seed_offset, n_intervals=n_intervals,
            interval_s=interval_s, substeps=substeps, apps=apps,
            cluster=cluster) for lam, seed in cells]
    if policy in torchsim.STATIC_DASO_ARMS:
        outs = torchsim.run_grid_arrays_static_daso(
            traces, policy, daso_theta=daso_theta, daso_cfg=daso_cfg,
            cluster=cluster, max_active=max_active, device=device,
            phase_s=phase_s)
    elif mab:
        if policy == "mab+gobi":
            daso_cfg = daso_cfg._replace(decision_aware=False)
        outs = torchsim.run_grid_arrays_learned(
            traces, mab_state, daso_theta=daso_theta if daso else None,
            daso_cfg=daso_cfg if daso else None, cluster=cluster,
            max_active=max_active, device=device,
            mab_hp=tuple(mab_hp or MAB_HP), phase_s=phase_s)
    else:
        dec = torchsim.make_static_decider(policy, mab_state=mab_state)
        traces = [torchsim.compile_trace(
            dec, lam=lam, seed=seed + seed_offset, n_intervals=n_intervals,
            interval_s=interval_s, substeps=substeps, apps=apps,
            cluster=cluster) for lam, seed in cells]
        outs = torchsim.run_grid_arrays(traces, cluster=cluster,
                                        max_active=max_active,
                                        device=device, phase_s=phase_s)
    return [_record(policy, seed, lam, out)
            for (lam, seed), out in zip(cells, outs)]
