"""AdamW, the port of ``repro.optim.optimizers``' ``adamw_init`` and
``adamw_update``, over lists of tensors.

The state and the arithmetic are float32 as in the reference: ``step``
is an int32 count, the bias corrections use ``b ** t`` with t the
float32 step, and ``eps`` is added to √v̂ before dividing.  Updates are
functional: new tensors are returned and the inputs are left as they
were.
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor          # () int32
    m: List[torch.Tensor]
    v: List[torch.Tensor]


def adamw_init(params: List[torch.Tensor], dtype=torch.float32) -> AdamWState:
    dev = params[0].device if params else None
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m=[torch.zeros(p.shape, dtype=dtype, device=p.device)
           for p in params],
        v=[torch.zeros(p.shape, dtype=dtype, device=p.device)
           for p in params])


def adamw_update(grads, state: AdamWState, params, lr, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1):
    """One AdamW step; returns (new params, new state)."""
    step = state.step + 1
    t = step.to(torch.float32)
    m = [b1 * m + (1 - b1) * g.to(m.dtype) for m, g in zip(state.m, grads)]
    v = [b2 * v + (1 - b2) * torch.square(g.to(v.dtype))
         for v, g in zip(state.v, grads)]
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t

    def upd(p, m, v):
        mh = m / bc1
        vh = v / bc2
        u = mh / (torch.sqrt(vh) + eps) + weight_decay * p.to(m.dtype)
        return (p.float() - lr * u).to(p.dtype)

    new_params = [upd(p, mi, vi) for p, mi, vi in zip(params, m, v)]
    return new_params, AdamWState(step=step, m=m, v=v)
