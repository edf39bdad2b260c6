"""Batched experiment runner of the port — (seed × λ) grids for one policy.

``run_grid_batched`` is the port of ``repro.launch.experiments
.run_grid_batched`` for the static BestFit policies and the ``"mab"``
policy in ``mode="deploy"``: the whole grid runs as one batched interval
program on the device (one row per grid cell).  Every other policy or
mode raises ``NotImplementedError`` naming the ROADMAP item that brings
it.
"""
from __future__ import annotations

import itertools
from typing import List, Optional, Sequence

from repro_torch.env import torchsim
from repro_torch.env.torchsim.driver import MAB_HP

#: policies of the reference not ported yet, with the ROADMAP queue-1
#: item that brings each
NOT_PORTED = {
    "splitplace": "item 6 (DASO placement, core/daso.py)",
    "mab+gobi": "item 6 (DASO placement, core/daso.py)",
    "layer+gobi": "item 6 (DASO placement, core/daso.py)",
    "semantic+gobi": "item 6 (DASO placement, core/daso.py)",
    "random+daso": "items 6 and 7 (DASO placement, in-loop randomness)",
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
                     max_active: Optional[int] = None, mab_hp=None,
                     mode: str = "deploy", device="cuda",
                     phase_s: Optional[dict] = None) -> List[dict]:
    """Run a whole (seed × λ) grid for one policy as ONE batched interval
    program on ``device``; one record per trace, in
    ``itertools.product(lams, seeds)`` order.

    Static policies (``torchsim.STATIC_POLICIES``) compile single-variant
    traces; ``"mab"`` compiles dual traces and carries one copy of
    ``mab_state`` per cell (online UCB decisions + Algorithm-1 feedback,
    BestFit placement).  ``phase_s`` collects the wall seconds of the
    program's phases (see ``driver.PHASES``).  Records report
    ``dropped_tasks`` (0 unless ``max_active`` was forced too small)."""
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
    if policy == "mab":
        if mab_state is None:
            raise ValueError("policy 'mab' needs a pretrained mab_state")
        traces = [torchsim.compile_trace_dual(
            lam=lam, seed=seed + seed_offset, n_intervals=n_intervals,
            interval_s=interval_s, substeps=substeps, apps=apps,
            cluster=cluster) for lam, seed in cells]
        outs = torchsim.run_grid_arrays_learned(
            traces, mab_state, cluster=cluster, max_active=max_active,
            device=device, mab_hp=tuple(mab_hp or MAB_HP), phase_s=phase_s)
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
