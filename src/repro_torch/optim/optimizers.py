"""AdamW and Adafactor, the port of ``repro.optim.optimizers``, over lists
of tensors; global-norm clipping and the warmup-cosine schedule.

The state and the arithmetic are float32 as in the reference: ``step``
is an int32 count, AdamW's bias corrections use ``b ** t`` with t the
float32 step and add ``eps`` to √v̂ before dividing.  ``adamw_update``
is functional (new tensors; ``core.daso`` steps with it).  The training
step's forms write in place: ``make_optimizer``'s update
(``adamw_update_``, ``adafactor_update_``) and ``clip_by_global_norm_``
write the new values into the given parameters, state and gradients,
AdamW and the clip (elementwise) a slice of ``SLICE`` elements at a
time, so that a step holds one copy of the model's state and one slice's
temporaries (the reference's jitted step gets the same from buffer
donation; a 1.05 B-entry embedding's float32 temporaries alone are
~30 GB).  ``adamw_update_`` gives ``adamw_update``'s bits.

Adafactor's statistics depend on how leaves are laid out: the reference
stacks a model's body periods along a leading axis, and ``_factored``,
the RMS clip and the unfactored rule then see the stacked leaf (a
per-layer norm stacked to (periods, d) is factored over periods × d).
The port keeps one tensor per layer, so ``adafactor_init`` and
``adafactor_update_`` take ``groups``: one entry per reference leaf, an
index into the list (a leaf as it is) or a list of indices (the layers'
tensors stacked along a new leading axis, as the reference stacks them;
``models.model.stack_groups``).  Without ``groups`` every tensor is its
own leaf.  The state's ``vr`` and ``vc`` hold one entry per group, in the
reference's shapes.
"""
from __future__ import annotations

import functools
import math
from typing import List, NamedTuple

import torch


#: elements per slice of an in-place elementwise update
SLICE = 1 << 24


def _slices(*tensors):
    """Matching flat slices of tensors of one shape, ``SLICE`` elements
    each (the whole tensors where one is not contiguous)."""
    if not all(t.is_contiguous() for t in tensors):
        yield tensors
        return
    flat = [t.view(-1) for t in tensors]
    for i in range(0, flat[0].numel(), SLICE):
        yield [f[i:i + SLICE] for f in flat]


def _local(t):
    """A DTensor's shard on this rank, any other tensor itself: the
    elementwise updates run on the shards, which is exact."""
    return t.to_local() if hasattr(t, "to_local") else t


def global_norm(tensors) -> torch.Tensor:
    """√(Σ x²) over every tensor, in float32 (a () tensor)."""
    total = None
    for x in tensors:
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    if total is None:
        return torch.zeros(())
    return torch.sqrt(total)


def clip_by_global_norm_(tensors, max_norm):
    """Scales each tensor in place by min(1, max_norm / max(norm, 1e-9)),
    in float32 and cast back to its dtype (the reference's
    ``clip_by_global_norm``); returns the norm."""
    n = global_norm(tensors)
    scale = _local(torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0))
    for x in tensors:
        for (part,) in _slices(_local(x)):
            part.copy_(part.float() * scale)
    return n


def warmup_cosine(step, peak_lr, warmup_steps=100, total_steps=10000,
                  min_ratio=0.1):
    """The learning rate at ``step`` (an int): linear warmup to
    ``peak_lr`` over ``warmup_steps``, then a cosine to ``min_ratio`` of
    it at ``total_steps``; a () float32 tensor equal to the reference's
    float32 value bit for bit (the cosine taken in float64 and rounded to
    float32, which XLA's float32 cosine equals where torch's float32 one
    is an ulp off)."""
    step = float(step)
    if step < warmup_steps:
        return peak_lr * torch.tensor(min(1.0, (step + 1) / warmup_steps),
                                      dtype=torch.float32)
    frac = torch.tensor(min(max((step - warmup_steps)
                                / max(1, total_steps - warmup_steps), 0.0),
                            1.0), dtype=torch.float32)
    cos = torch.cos((frac * math.pi).double()).float()
    return peak_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + cos))


# ------------------------------------------------------------------ AdamW

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


def _adamw_leaf(p, g, m, v, bc1, bc2, lr, b1, b2, eps, weight_decay):
    """(new p, new m, new v) of one leaf."""
    m = b1 * m + (1 - b1) * g.to(m.dtype)
    v = b2 * v + (1 - b2) * torch.square(g.to(v.dtype))
    mh = m / bc1
    vh = v / bc2
    u = mh / (torch.sqrt(vh) + eps) + weight_decay * p.to(m.dtype)
    return (p.float() - lr * u).to(p.dtype), m, v


def _bias_corrections(state, b1, b2):
    step = state.step + 1
    t = step.to(torch.float32)
    return step, 1 - b1 ** t, 1 - b2 ** t


def adamw_update(grads, state: AdamWState, params, lr, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1):
    """One AdamW step; returns (new params, new state)."""
    step, bc1, bc2 = _bias_corrections(state, b1, b2)
    hp = (lr, b1, b2, eps, weight_decay)
    out = [_adamw_leaf(p, g, m, v, bc1, bc2, *hp)
           for p, g, m, v in zip(params, grads, state.m, state.v)]
    return [o[0] for o in out], AdamWState(step=step, m=[o[1] for o in out],
                                           v=[o[2] for o in out])


def adamw_update_(grads, state: AdamWState, params, lr, b1=0.9, b2=0.95,
                  eps=1e-8, weight_decay=0.1):
    """``adamw_update`` written into ``params`` and the state's moments, a
    slice at a time; returns those same tensors (params, state)."""
    step, bc1, bc2 = _bias_corrections(state, b1, b2)
    bc1, bc2 = _local(bc1), _local(bc2)
    hp = (lr, b1, b2, eps, weight_decay)
    for leaf in zip(params, grads, state.m, state.v):
        for p, g, m, v in _slices(*map(_local, leaf)):
            for old, new in zip((p, m, v), _adamw_leaf(p, g, m, v, bc1, bc2,
                                                       *hp)):
                old.copy_(new)
    return list(params), AdamWState(step=step, m=state.m, v=state.v)


# --------------------------------------------------------------- Adafactor

class AdafactorState(NamedTuple):
    step: torch.Tensor          # () int32
    vr: List[torch.Tensor]      # row statistics (or full v for <2-D leaves)
    vc: List[torch.Tensor]      # column statistics ((1,) for <2-D leaves)


def _factored(shape):
    return len(shape) >= 2 and shape[-1] >= 2 and shape[-2] >= 2


def _groups(n, groups):
    return list(range(n)) if groups is None else groups


def _leaf(tensors, group):
    """The reference's leaf of ``group``: one tensor, or the group's
    tensors stacked along a new leading axis."""
    if isinstance(group, int):
        return tensors[group]
    return torch.stack([tensors[i] for i in group])


def adafactor_init(params: List[torch.Tensor], groups=None):
    vr, vc = [], []
    for group in _groups(len(params), groups):
        first = params[group if isinstance(group, int) else group[0]]
        shape = tuple(first.shape) if isinstance(group, int) \
            else (len(group),) + tuple(first.shape)
        kw = dict(dtype=torch.float32, device=first.device)
        if _factored(shape):
            vr.append(torch.zeros(shape[:-1], **kw))
            vc.append(torch.zeros(shape[:-2] + shape[-1:], **kw))
        else:
            vr.append(torch.zeros(shape, **kw))
            vc.append(torch.zeros((1,), **kw))
    dev = params[0].device if params else None
    return AdafactorState(step=torch.zeros((), dtype=torch.int32, device=dev),
                          vr=vr, vc=vc)


def adafactor_update_(grads, state: AdafactorState, params, lr, groups=None,
                      decay_pow=0.8, eps=1e-30, clip_threshold=1.0,
                      weight_decay=0.0):
    """One Adafactor step over ``groups`` (see the module's docstring),
    written into ``params`` and the state's statistics group by group;
    returns those same tensors (params, state)."""
    step = state.step + 1
    t = step.to(torch.float32)
    beta2 = 1.0 - t ** (-decay_pow)

    def upd(p, g, vr, vc):
        g = g.float()
        g2 = torch.square(g) + eps
        if _factored(p.shape):
            vr_n = beta2 * vr + (1 - beta2) * g2.mean(-1)
            vc_n = beta2 * vc + (1 - beta2) * g2.mean(-2)
            denom = (vr_n / torch.clamp(vr_n.mean(-1, keepdim=True),
                                        min=eps))[..., None] \
                * vc_n[..., None, :]
            u = g * torch.rsqrt(torch.clamp(denom, min=eps))
        else:
            vr_n, vc_n = beta2 * vr + (1 - beta2) * g2, vc
            u = g * torch.rsqrt(torch.clamp(vr_n, min=eps))
        rms = torch.sqrt(torch.mean(torch.square(u)) + eps)
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        new_p = p.float() - lr * (u + weight_decay * p.float())
        return new_p.to(p.dtype), vr_n, vc_n

    for group, vr_i, vc_i in zip(_groups(len(params), groups), state.vr,
                                 state.vc):
        p, vr_n, vc_n = upd(_leaf(params, group), _leaf(grads, group), vr_i,
                            vc_i)
        if isinstance(group, int):
            params[group].copy_(p)
        else:
            for j, i in enumerate(group):
                params[i].copy_(p[j])
        vr_i.copy_(vr_n)
        vc_i.copy_(vc_n)
    return list(params), AdafactorState(step=step, vr=state.vr, vc=state.vc)


def make_optimizer(name: str, groups=None):
    """(init(params), update(grads, state, params, lr)) of ``"adamw"`` or
    ``"adafactor"`` (over ``groups``; AdamW is elementwise and needs
    none); the update writes into the parameters and state
    (``adamw_update_``, ``adafactor_update_``)."""
    if name == "adamw":
        return adamw_init, adamw_update_
    if name == "adafactor":
        return (functools.partial(adafactor_init, groups=groups),
                functools.partial(adafactor_update_, groups=groups))
    raise ValueError(name)
