"""Batched experiment runner of the port — (seed × λ) grids for one policy.

``run_grid_batched`` is the port of ``repro.launch.experiments
.run_grid_batched``: the static BestFit policies, the MAB policies
``"mab"``, ``"splitplace"`` and ``"mab+gobi"`` in ``mode="deploy"`` (UCB)
and ``mode="train"`` (ε-greedy decisions and online DASO finetuning), the
Gillis baseline and the static-decider DASO arms ``"layer+gobi"``,
``"semantic+gobi"`` and ``"random+daso"``: the whole grid runs as one
batched interval program on the device (one row per grid cell).
``pretrain`` is not ported: the DASO policies take θ and its cfg from the
caller.
"""
from __future__ import annotations

import itertools
from typing import List, Optional, Sequence

from repro_torch.env import torchsim
from repro_torch.env.torchsim.driver import MAB_HP, TRAIN_HP
from repro_torch.env.workload import COMPRESSED, LAYER

#: policies of the reference not ported yet, with the ROADMAP queue-1
#: item that brings each (none is left)
NOT_PORTED: dict = {}

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
                     train_hp=None, gillis_state=None, daso_opt_state=None,
                     device="cuda",
                     phase_s: Optional[dict] = None) -> List[dict]:
    """Run a whole (seed × λ) grid for one policy as ONE batched interval
    program on ``device``; one record per trace, in
    ``itertools.product(lams, seeds)`` order.

    Static policies (``torchsim.STATIC_POLICIES``) compile single-variant
    traces.  The MAB policies (``torchsim.MAB_LEARNED_POLICIES``) compile
    dual traces and carry one copy of ``mab_state`` per cell; ``"mab"``
    places with BestFit, ``"splitplace"`` with the DASO stage ascending
    ``daso_theta`` under ``daso_cfg``, ``"mab+gobi"`` with the same cfg
    made decision-blind.  ``mode="deploy"`` decides by UCB;
    ``mode="train"`` runs the §6.3 training loop: ε-greedy decisions and,
    for the surrogate placers, online finetuning of a per-cell copy of θ
    (from ``daso_opt_state``'s AdamW moments, or fresh ones) under
    ``train_hp`` (default ``driver.TRAIN_HP``).  ``"gillis"`` compiles
    (LAYER, COMPRESSED) dual traces and learns its Q-table in the loop
    from ``gillis_state`` (zeros and ε₀ when None); it is online in either
    mode.  ``"layer+gobi"`` / ``"semantic+gobi"`` fix the split and
    ``"random+daso"`` draws it per row, each placed by the DASO stage; they
    need θ and cfg but no ``mab_state``, and ignore ``mode``.  ``phase_s``
    collects the wall seconds of the program's phases (see
    ``driver.PHASES``).  Records report ``dropped_tasks`` (0 unless
    ``max_active`` was forced too small)."""
    if mode not in ("deploy", "train"):
        raise ValueError(f"unknown mode {mode!r}")
    cells = list(itertools.product(lams, seeds))

    def dual(**kw):
        return [torchsim.compile_trace_dual(
            lam=lam, seed=seed + seed_offset, n_intervals=n_intervals,
            interval_s=interval_s, substeps=substeps, apps=apps,
            cluster=cluster, **kw) for lam, seed in cells]

    run_kw = dict(cluster=cluster, max_active=max_active, device=device,
                  phase_s=phase_s)
    if policy == "gillis":
        outs = torchsim.run_grid_arrays_gillis(
            dual(variants=(LAYER, COMPRESSED)), gillis_state, **run_kw)
    elif policy in torchsim.STATIC_DASO_ARMS:
        if daso_theta is None or daso_cfg is None:
            raise ValueError(f"policy {policy!r} needs daso_theta/daso_cfg")
        outs = torchsim.run_grid_arrays_static_daso(
            dual(), policy, daso_theta=daso_theta, daso_cfg=daso_cfg,
            **run_kw)
    elif policy in torchsim.MAB_LEARNED_POLICIES:
        if mab_state is None:
            raise ValueError(f"policy {policy!r} needs a pretrained "
                             "mab_state")
        use_daso = policy in torchsim.DASO_LEARNED_POLICIES
        if use_daso and (daso_theta is None or daso_cfg is None):
            raise ValueError(f"policy {policy!r} needs daso_theta/daso_cfg")
        cfg = daso_cfg._replace(decision_aware=False) \
            if policy == "mab+gobi" else daso_cfg
        daso_kw = dict(daso_theta=daso_theta if use_daso else None,
                       daso_cfg=cfg if use_daso else None,
                       mab_hp=tuple(mab_hp or MAB_HP))
        if mode == "train":
            outs = torchsim.run_grid_arrays_trained(
                dual(), mab_state,
                daso_opt_state=daso_opt_state if use_daso else None,
                train_hp=tuple(train_hp or TRAIN_HP), **daso_kw, **run_kw)
        else:
            outs = torchsim.run_grid_arrays_learned(dual(), mab_state,
                                                    **daso_kw, **run_kw)
    else:
        if mode == "train":
            raise ValueError(f"policy {policy!r} is static — mode='train' "
                             f"needs a learned policy "
                             f"({torchsim.LEARNED_POLICIES})")
        dec = torchsim.make_static_decider(policy, mab_state=mab_state)
        traces = [torchsim.compile_trace(
            dec, lam=lam, seed=seed + seed_offset, n_intervals=n_intervals,
            interval_s=interval_s, substeps=substeps, apps=apps,
            cluster=cluster) for lam, seed in cells]
        outs = torchsim.run_grid_arrays(traces, **run_kw)
    return [_record(policy, seed, lam, out)
            for (lam, seed), out in zip(cells, outs)]
