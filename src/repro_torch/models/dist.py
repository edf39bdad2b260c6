"""DTensor placement at the model's mesh-sensitive points.

With a mesh (``launch.sharding``) the model's tensors are DTensors, and
a few of its views and reductions need their operands placed first: a
(b, s) flatten of a sequence-split activation, a head split the kv heads
cannot divide, and their gradients.  Each helper here is the identity on
a plain tensor, so a call without a mesh computes what it always did.
"""
from __future__ import annotations

import torch


def constrained(constrain, x, kind):
    """``constrain(x, kind)`` (``launch.sharding.make_constrain``: the
    reference's ``with_sharding_constraint`` points), or x as it is when
    there is no mesh."""
    return x if constrain is None else constrain(x, kind)


def placed(y, placements, grad_placements):
    """The DTensor ``y`` in ``placements``, its gradient returned in
    ``grad_placements`` (``_Placed``)."""
    return _Placed.apply(y, tuple(placements), tuple(grad_placements))


class _Placed(torch.autograd.Function):
    """A DTensor redistributed to ``placements``, and its gradient to
    ``grad_placements`` (not sent back to the input's placements, which a
    view of the gradient could not split evenly either)."""

    @staticmethod
    def forward(ctx, y, placements, grad_placements):
        ctx.grad_placements = grad_placements
        if tuple(y.placements) == placements:
            return y.view_as(y)
        return y.redistribute(y.device_mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) != ctx.grad_placements:
            grad = grad.redistribute(grad.device_mesh, ctx.grad_placements)
        return grad, None, None


def _whole_groups(y, groups):
    """``y``'s placements with a split of its last dim over a mesh
    dimension that does not divide ``groups`` replaced by Replicate."""
    from torch.distributed.tensor import Replicate, Shard
    last = Shard(y.dim() - 1)
    return tuple(Replicate() if p == last and groups % y.device_mesh.size(i)
                 else p for i, p in enumerate(y.placements))


def unflatten_last(y, sizes):
    """y (..., prod(sizes)) as (..., *sizes).  A DTensor split over its
    last dim on a mesh dimension that does not divide ``sizes[0]`` (kv
    heads fewer than the mesh axis) is first gathered along that mesh
    dimension, and so is its gradient; a plain tensor is a view, as
    always."""
    if hasattr(y, "placements"):
        want = _whole_groups(y, sizes[0])
        if want != tuple(y.placements):
            y = placed(y, want, want)
    return y.unflatten(-1, sizes)


def flatten_last2(t):
    """t (..., h, e) as (..., h·e); for a DTensor the gradient of the
    flat tensor comes back with its last dim gathered along the mesh
    dimensions that do not divide h, so that it unflattens (the inverse
    of ``unflatten_last``)."""
    y = t.flatten(-2)
    if hasattr(y, "placements"):
        y = placed(y, y.placements, _whole_groups(y, t.shape[-2]))
    return y


def seq_gathered(x):
    """A DTensor (b, s, ...) split over its sequence dim, gathered along
    the mesh dimensions that split it (the residual stream is
    sequence-parallel, the products and the routing read whole
    sequences: a (b, s) flatten of a split sequence has no DTensor
    layout); any other tensor as it is."""
    if not hasattr(x, "placements") or x.dim() < 3:
        return x
    from torch.distributed.tensor import Replicate, Shard
    want = tuple(Replicate() if p == Shard(1) else p for p in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)
