"""Decider / Placer contracts (the two halves of a SplitPlace policy).

The seed code passed deciders and placers around duck-typed; this module
pins the contract down so new strategies (and the batched experiment
runner in ``repro_torch.launch.experiments``) can be written and type-checked
against an explicit surface.

A *decider* maps newly arrived tasks to split decisions (LAYER /
SEMANTIC / COMPRESSED, Algorithm 1 line 4); a *placer* maps the active
container set to workers (line 7).  Both observe the end-of-interval
outcome through ``feedback``.  A copy of the reference
``repro.core.policies``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Protocol, Tuple, runtime_checkable


@runtime_checkable
class Decider(Protocol):
    def decide(self, tasks: List) -> List[int]:
        """Split decision per task (tasks are not yet realized)."""
        ...

    def feedback(self, finished: List) -> None:
        """Observe tasks that completed this interval (response/accuracy
        populated); learning deciders update their state here."""
        ...


@runtime_checkable
class Placer(Protocol):
    def place(self, sim) -> Dict[Tuple[int, int], int]:
        """Assignment ``(task_id, fragment_idx) -> worker`` for active
        containers.  Fragments omitted from the dict keep their current
        worker; the simulator feasibility-repairs the result against
        worker RAM (``EdgeSim.apply_placement``)."""
        ...

    def feedback(self, *args, **kwargs) -> None:
        """Observe the interval outcome (surrogate placers record the
        QoS target O^P here and finetune)."""
        ...


@dataclasses.dataclass
class Policy:
    """A named (decider, placer) pair — one Table 4 row."""
    name: str
    decider: Decider
    placer: Placer
